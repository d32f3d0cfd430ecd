"""Single-page HTML console for the web toolbox (`serve/http.py`).

A copy of ``mockingbird_tpu/serve/console.py`` (the port imports nothing of
the JAX package); the page is the same, byte for byte.

Browser-side equivalent of the reference's PyQt5 UI (`control/toolbox/ui.py`):
dataset browser, record/play, embedding heatmap + 2-D projection scatter,
synthesize→vocode with seed/style controls, vocoder hot-swap, VC tab and
background-job panel — all vanilla JS + canvas on the stdlib HTTP API.
"""

INDEX_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>mockingbird_tpu toolbox</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#101418;color:#e6e8ea}
 header{padding:10px 20px;background:#161b22;border-bottom:1px solid #2d333b}
 h1{font-size:18px;margin:0} h3{margin:6px 0;font-size:14px;color:#9ab}
 main{display:grid;grid-template-columns:340px 1fr 1fr;gap:12px;padding:12px}
 section{background:#161b22;border:1px solid #2d333b;border-radius:8px;padding:12px}
 select,input,button,textarea{background:#0d1117;color:#e6e8ea;border:1px solid #2d333b;
   border-radius:4px;padding:4px 6px;margin:2px 0;font-size:13px}
 button{cursor:pointer;background:#1f6feb;border:none;padding:5px 10px}
 button.alt{background:#30363d} button:disabled{opacity:.4}
 select{width:100%} textarea{width:100%;box-sizing:border-box}
 canvas{background:#0d1117;border:1px solid #2d333b;border-radius:4px;width:100%}
 .row{display:flex;gap:6px;align-items:center;flex-wrap:wrap}
 .muted{color:#8b949e;font-size:12px} audio{width:100%;height:28px}
 #log{font-family:monospace;font-size:11px;white-space:pre-wrap;max-height:140px;
   overflow-y:auto;color:#7ee787}
</style></head><body>
<header><h1>mockingbird_tpu — voice-cloning toolbox</h1>
<span class="muted">TPU-native rebuild of MockingBird · dataset browser · clone · convert</span></header>
<main>
<section>
 <h3>Dataset browser</h3>
 <select id="dataset"></select>
 <select id="speaker"></select>
 <select id="utterance" size="8"></select>
 <div class="row">
  <button id="random">Random</button>
  <button id="load" class="alt">Load</button>
  <button id="record" class="alt">Record 5s</button>
 </div>
 <audio id="refAudio" controls></audio>
 <div class="row"><button id="embed">Embed utterance</button>
  <span class="muted" id="embedInfo"></span></div>
 <h3>Embedding</h3>
 <canvas id="embedCanvas" width="256" height="64"></canvas>
 <h3>Projection (session)</h3>
 <canvas id="projCanvas" width="300" height="200"></canvas>
</section>
<section>
 <h3>Synthesize</h3>
 <textarea id="text" rows="3">ni3 hao3 shi4 jie4 zhe4 shi4 yi2 ge4 ce4 shi4</textarea>
 <div class="row">
  seed <input id="seed" size="6" value="">
  <label><input type="checkbox" id="randomSeed"> random</label>
  style <input id="style" size="3" value="0">
 </div>
 <div class="row"><button id="synth">Synthesize</button>
  <span class="muted" id="synthInfo"></span></div>
 <h3>Mel spectrogram</h3>
 <canvas id="melCanvas" width="560" height="160"></canvas>
 <h3>Vocode</h3>
 <div class="row">
  <select id="vocoder" style="width:auto">
   <option value="hifigan">HiFi-GAN</option>
   <option value="fregan">Fre-GAN</option>
   <option value="wavernn">WaveRNN</option>
   <option value="griffinlim">Griffin-Lim</option>
  </select>
  <button id="vocode">Vocode</button>
  <span class="muted" id="vocodeInfo"></span>
 </div>
 <audio id="genAudio" controls></audio>
</section>
<section>
 <h3>Voice conversion (one-shot)</h3>
 <div class="row">target voice <input type="file" id="vcRef" accept=".wav"></div>
 <div class="row">source speech <input type="file" id="vcSrc" accept=".wav"></div>
 <div class="row">
  <select id="vcVocoder" style="width:auto">
   <option value="hifigan">HiFi-GAN</option><option value="fregan">Fre-GAN</option>
   <option value="wavernn">WaveRNN</option>
  </select>
  <button id="convert">Convert</button><span class="muted" id="vcInfo"></span></div>
 <audio id="vcAudio" controls></audio>
 <h3>Jobs</h3>
 <div class="row">
  <button id="jobPre" class="alt">Preprocess…</button>
  <button id="jobTrain" class="alt">Train…</button>
 </div>
 <div id="jobs" class="muted">no jobs</div>
 <h3>Models</h3><div id="models" class="muted"></div>
 <h3>Log</h3><div id="log"></div>
</main>
<script>
const $=id=>document.getElementById(id);
const log=m=>{$('log').textContent+=m+"\n";$('log').scrollTop=1e9};
async function j(url,opts){const r=await fetch(url,opts);
 if(!r.ok){const t=await r.text();throw new Error(t)}
 const ct=r.headers.get('content-type')||'';
 return ct.includes('json')?r.json():r.blob()}
let refBlob=null, lastUtterance=null;

async function browse(){
 const d=$('dataset').value,s=$('speaker').value;
 const q=new URLSearchParams(); if(d)q.set('dataset',d); if(s)q.set('speaker',s);
 const res=await j('/api/datasets?'+q);
 const fill=(el,items,keep)=>{const v=el.value;el.innerHTML='';
  items.forEach(x=>{const o=document.createElement('option');o.textContent=x;el.append(o)});
  if(keep&&items.includes(v))el.value=v};
 fill($('dataset'),res.datasets,true);
 if(res.speakers.length)fill($('speaker'),res.speakers,true);
 if(res.utterances.length)fill($('utterance'),res.utterances,false);
}
$('dataset').onchange=()=>{$('speaker').innerHTML='';$('utterance').innerHTML='';browse()};
$('speaker').onchange=()=>{$('utterance').innerHTML='';browse()};
$('random').onclick=async()=>{const r=await j('/api/datasets?random=1');
 if(r.error)return log(r.error);
 $('dataset').value=r.dataset;await browse();$('speaker').value=r.speaker;
 await browse();$('utterance').value=r.utterance};
$('load').onclick=async()=>{const u=$('utterance').value;if(!u)return;
 const b=await j('/api/audio?path='+encodeURIComponent(u));
 refBlob=b;lastUtterance=u;$('refAudio').src=URL.createObjectURL(b);log('loaded '+u)};
$('record').onclick=async()=>{
 try{const stream=await navigator.mediaDevices.getUserMedia({audio:true});
  const rec=new MediaRecorder(stream);const chunks=[];
  rec.ondataavailable=e=>chunks.push(e.data);
  rec.onstop=()=>{refBlob=new Blob(chunks);lastUtterance='rec_'+Date.now();
   $('refAudio').src=URL.createObjectURL(refBlob);log('recorded')};
  rec.start();log('recording 5s…');setTimeout(()=>rec.stop(),5000);
 }catch(e){log('record failed: '+e)}};

function drawEmbed(embed){const c=$('embedCanvas'),g=c.getContext('2d');
 const img=g.createImageData(256,64);
 for(let i=0;i<256;i++){const v=Math.max(0,Math.min(1,embed[i]*4));
  for(let y=0;y<64;y++){const p=4*(y*256+i);
   img.data[p]=30+v*200;img.data[p+1]=60+v*140;img.data[p+2]=120;img.data[p+3]=255}}
 g.putImageData(img,0,0)}
function drawProj(st){const c=$('projCanvas'),g=c.getContext('2d');
 g.clearRect(0,0,c.width,c.height);g.font='10px monospace';
 st.projection.forEach((p,i)=>{const x=10+p[0]*(c.width-20),y=10+p[1]*(c.height-20);
  g.fillStyle='hsl('+(i*67%360)+',70%,60%)';
  g.beginPath();g.arc(x,y,4,0,7);g.fill();g.fillText(st.names[i].slice(-18),x+6,y+3)})}
function drawMel(mel){const c=$('melCanvas'),g=c.getContext('2d');
 const H=mel.length,W=mel[0].length;c.width=W;c.height=H*2;
 const img=g.createImageData(W,H*2);
 for(let y=0;y<H*2;y++)for(let x=0;x<W;x++){const v=mel[H-1-(y>>1)][x]/255;
  const p=4*(y*W+x);img.data[p]=v*255;img.data[p+1]=v*180;img.data[p+2]=80+v*60;
  img.data[p+3]=255}
 g.putImageData(img,0,0)}

$('embed').onclick=async()=>{
 if(!refBlob)return log('load or record an utterance first');
 const fd=new FormData();fd.append('ref',refBlob,'ref.wav');
 fd.append('name',lastUtterance||'utt');
 const r=await j('/api/embed',{method:'POST',body:fd});
 $('embedInfo').textContent='256-d ok';drawEmbed(r.embed);drawProj(r);
 log('embedded '+r.name)};
$('synth').onclick=async()=>{
 $('synth').disabled=true;$('synthInfo').textContent='…';
 try{const body={text:$('text').value,utterance:lastUtterance,
   style_idx:+$('style').value||0};
  if($('randomSeed').checked)body.seed=Math.floor(Math.random()*1e6);
  else if($('seed').value)body.seed=+$('seed').value;
  const r=await j('/api/synthesize_mel',{method:'POST',
   headers:{'content-type':'application/json'},body:JSON.stringify(body)});
  drawMel(r.mel);
  $('synthInfo').textContent=r.mel_shape[1]+' frames, '+r.seconds.toFixed(2)+'s audio in '
   +r.elapsed.toFixed(2)+'s';
 }catch(e){log('synthesize: '+e.message)}
 $('synth').disabled=false};
$('vocode').onclick=async()=>{
 $('vocode').disabled=true;$('vocodeInfo').textContent='…';
 try{const r=await fetch('/api/vocode',{method:'POST',
   headers:{'content-type':'application/json'},
   body:JSON.stringify({vocoder:$('vocoder').value})});
  if(!r.ok)throw new Error(await r.text());
  $('vocodeInfo').textContent=(r.headers.get('x-rtf')||'')+'x realtime';
  $('genAudio').src=URL.createObjectURL(await r.blob());$('genAudio').play();
 }catch(e){log('vocode: '+e.message)}
 $('vocode').disabled=false};
$('convert').onclick=async()=>{
 const ref=$('vcRef').files[0],src=$('vcSrc').files[0];
 if(!ref||!src)return log('pick both wavs');
 $('convert').disabled=true;$('vcInfo').textContent='…';
 try{const fd=new FormData();fd.append('ref',ref);fd.append('src',src);
  fd.append('vocoder',$('vcVocoder').value);
  const r=await fetch('/api/convert',{method:'POST',body:fd});
  if(!r.ok)throw new Error(await r.text());
  $('vcInfo').textContent='RTF '+(r.headers.get('x-rtf')||'?');
  $('vcAudio').src=URL.createObjectURL(await r.blob());
 }catch(e){log('convert: '+e.message)}
 $('convert').disabled=false};
$('jobPre').onclick=async()=>{const root=prompt('datasets_root?');if(!root)return;
 const ds=prompt('dataset?','aidatatang_200zh')||'aidatatang_200zh';
 log(JSON.stringify(await j('/api/preprocess',{method:'POST',
  body:JSON.stringify({datasets_root:root,dataset:ds})})))};
$('jobTrain').onclick=async()=>{const kind=prompt('kind? synth/vits/vc','synth');
 const syn=prompt('syn_dir?');if(!kind||!syn)return;
 log(JSON.stringify(await j('/api/train',{method:'POST',
  body:JSON.stringify({kind:kind,syn_dir:syn})})))};
async function poll(){try{
  const jobs=await j('/api/jobs');
  $('jobs').textContent=Object.keys(jobs).length?
   Object.entries(jobs).map(([k,v])=>k+': '+v.state).join(' · '):'no jobs';
 }catch(e){} setTimeout(poll,3000)}
(async()=>{await browse();poll();
 try{const m=await j('/api/models');
  $('models').textContent=Object.entries(m).map(([k,v])=>k+': '+
   (v.length?v.join(', '):'(fresh)')).join(' | ')}catch(e){}})();
</script></body></html>"""
