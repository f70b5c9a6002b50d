"""The viewer's embedded WebGL2 page: the port's own copy of
``facebook360_dep_tpu/viewer/page.py``, whose page text it equals.

Implements the reference RigScene pipeline in the browser
(``render/RigScene.cpp:195-320, 995-1096``):

- per camera ("subframe"): draw its displaced mesh (world positions
  precomputed by the server from the equi-error .vtx, exactly cameraMeshVS's
  ``camera + (focal/c) * direction(a,b)``) depth-tested into a private
  subframe FBO with cone alpha ``max(eps, 1 - 2*length(uv - 0.5))``
  (cameraFS); a separate background-layer mesh, when the server advertises
  one, draws into the same subframe after the foreground (renderSubframe
  :955-966);
- per-camera frustum culling: skip cameras whose near-infinity probe points
  (server-computed, isVisible :1040-1066) all fall outside the frustum;
- updateAccumulation (:1009): a fullscreen pass re-weights the subframe's
  alpha exponentially ``a' = exp(30 a) - 1`` (exponentialFS :281-292) and
  blends premultiplied-additively (SRC_ALPHA,ONE / ONE,ONE) into an RGBA32F
  accumulation FBO;
- resolveAccumulation (:1022): divide RGB by accumulated alpha scaled by the
  displacement fade (1 within 0.5 m of the rig, ramps to 0.05 by 0.75 m,
  squared — render() :1087-1095).

Controls: drag = look, WASD/QE = move, scroll = dolly, [/] = frame step,
space = play, 3 = side-by-side ODS stereo (the per-vertex IPD warp of
``RigScene.cpp:86-131``, kIPD = +-halfIpdM per eye). No external assets
(zero-egress friendly).
"""

HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>facebook360_dep_tpu 6DoF viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#000;color:#9ab;font:12px monospace}
 #hud{position:fixed;left:8px;top:8px;z-index:2;white-space:pre;text-shadow:0 0 4px #000}
 canvas{width:100vw;height:100vh;display:block}
</style></head>
<body><div id="hud">loading…</div><canvas id="gl"></canvas>
<script>
"use strict";
const canvas = document.getElementById("gl");
const hud = document.getElementById("hud");
const gl = canvas.getContext("webgl2", {antialias: false});
if (!gl) hud.textContent = "WebGL2 unavailable";
const floatOK = gl && !!gl.getExtension("EXT_color_buffer_float");

// --- tiny mat4 (column major, WebGL convention) ----------------------------
function mul(a,b){const o=new Float32Array(16);for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s}return o}
function persp(fovy,aspect,near,far){const f=1/Math.tan(fovy/2),o=new Float32Array(16);o[0]=f/aspect;o[5]=f;o[10]=(far+near)/(near-far);o[11]=-1;o[14]=2*far*near/(near-far);return o}
function lookDir(eye,yaw,pitch){
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const f=[cy*cp,sp,sy*cp];           // forward
  const r=[ -sy,0,cy ];               // right (world up = +y)
  const u=[-cy*sp,cp,-sy*sp];
  const o=new Float32Array(16);
  o[0]=r[0];o[4]=r[1];o[8]=r[2];
  o[1]=u[0];o[5]=u[1];o[9]=u[2];
  o[2]=-f[0];o[6]=-f[1];o[10]=-f[2];
  o[12]=-(r[0]*eye[0]+r[1]*eye[1]+r[2]*eye[2]);
  o[13]=-(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2]);
  o[14]= (f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2]);
  o[15]=1;return {m:o,f,r,u};
}

// --- shaders (RigScene.cpp equivalents) ------------------------------------
// ODS stereo warp (cameraVS, RigScene.cpp:86-131): each view ray leaves a
// pupil circle of diameter ipd(lat) in the rig's equatorial plane (rig z
// up), rolling off to zero at the poles; kIPD > 0 = left eye, 0 = mono.
// Same math as render/dibr.py ods_eye_offset — Newton on the tangency
// residual, then the multiplied-through pole-stable 2x2 solve.
const meshVS=`#version 300 es
uniform mat4 transform; uniform float kIPD;
in vec3 pos; in vec2 uv; out vec2 texVar;
float ipdLat(float lat){
  const float a = 25.0, b = 0.17, pi = 3.141592653589793;
  float t = lat / pi;
  return kIPD * exp(-exp(a*(b-0.5-t)) - exp(a*(b-0.5+t)));
}
vec3 odsEye(vec3 p){
  float rxy2 = dot(p.xy, p.xy);
  float e0 = 0.5 * ipdLat(atan(p.z, sqrt(rxy2)));
  float d = sqrt(max(rxy2 - e0*e0, 1e-12));
  for (int i = 0; i < 2; ++i){
    float h = 1e-3*d + 1e-12;
    float ea = 0.5*ipdLat(atan(p.z, d));
    float r0 = rxy2 - ea*ea - d*d;
    float eb = 0.5*ipdLat(atan(p.z, d+h));
    float r1 = rxy2 - eb*eb - (d+h)*(d+h);
    float de = (r1 - r0) / h;
    d = max(d - r0 / (abs(de) > 1e-12 ? de : -2.0*max(d, 1e-6)), 0.0);
  }
  float s = 0.5 * ipdLat(atan(p.z, d));
  float inv = 1.0 / max(s*s + d*d, 1e-20);
  return vec3(s*(s*p.x - d*p.y)*inv, s*(d*p.x + s*p.y)*inv, 0.0);
}
void main(){
  texVar = uv;
  vec3 rig = pos;
  if (kIPD != 0.0) rig -= odsEye(rig);  // adjust rig when rendering stereo
  gl_Position = transform * vec4(rig, 1.0);
}`;
// cameraFS: raw color + cone alpha into the subframe (RigScene.cpp:244-259)
const meshFS=`#version 300 es
precision highp float; uniform sampler2D tex; in vec2 texVar; out vec4 color;
void main(){
  vec3 c = texture(tex, texVar).rgb;
  float cone = max(1.0/255.0, 1.0 - 2.0*length(texVar - 0.5));
  color = vec4(c, cone);
}`;
const quadVS=`#version 300 es
in vec2 tex; out vec2 texVar;
void main(){ gl_Position = vec4(2.0*tex-1.0, 0.0, 1.0); texVar = tex; }`;
// exponentialFS (RigScene.cpp:281-292): a' = exp(30 a) - 1, blended
// SRC_ALPHA,ONE / ONE,ONE into the accumulation buffer (updateAccumulation)
const updateFS=`#version 300 es
precision highp float; uniform sampler2D tex; in vec2 texVar; out vec4 color;
void main(){
  color = texture(tex, texVar);
  color.a = exp(30.0 * color.a) - 1.0;
}`;
// resolveFS (RigScene.cpp:294-307): fade * premul.rgb / premul.a
const quadFS=`#version 300 es
precision highp float; uniform sampler2D tex; uniform float fade;
in vec2 texVar; out vec4 color;
void main(){
  vec4 a = texture(tex, texVar);
  color = vec4(a.a > 0.0 ? fade * a.rgb / a.a : vec3(0.0), 1.0);
}`;
function shader(type,src){const s=gl.createShader(type);gl.shaderSource(s,src);gl.compileShader(s);
  if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(s);return s}
function program(vs,fs,attrs){const p=gl.createProgram();gl.attachShader(p,shader(gl.VERTEX_SHADER,vs));
  gl.attachShader(p,shader(gl.FRAGMENT_SHADER,fs));
  (attrs||[]).forEach((name,loc)=>gl.bindAttribLocation(p,loc,name));
  gl.linkProgram(p);
  if(!gl.getProgramParameter(p,gl.LINK_STATUS))throw gl.getProgramInfoLog(p);return p}

// --- state -----------------------------------------------------------------
let scene=null, meshes={}, textures={}, frames=[], frameIdx=0, playing=false;
let eye=[0,0,0], yaw=0.0, pitch=0.0, rigCenter=[0,0,0];
// side-by-side ODS stereo; 0.032 = the reference's halfIpdM uniform value
// (SimpleMeshRenderer.cpp:409, RiftViewer feeds the same shader per eye)
let stereo=false; const halfIpdM=0.032;
const progMesh = gl && program(meshVS, meshFS, ["pos","uv"]);
const progUpdate = gl && program(quadVS, updateFS, ["tex"]);
const progQuad = gl && program(quadVS, quadFS, ["tex"]);
let accumFBO=null, accumTex=null, subFBO=null, subTex=null, subDepth=null, fbw=0, fbh=0;
const quadBuf = gl && gl.createBuffer();
if (gl){gl.bindBuffer(gl.ARRAY_BUFFER, quadBuf);
  gl.bufferData(gl.ARRAY_BUFFER, new Float32Array([0,0,1,0,0,1,1,1]), gl.STATIC_DRAW);}
window.viewerState = {ready:false, drawn:0, culled:0, frames:0, floatOK, fade:1, stereo:false};

function makeTex(w,h,fmt){
  const t = gl.createTexture();
  gl.bindTexture(gl.TEXTURE_2D, t);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.NEAREST);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.NEAREST);
  gl.texStorage2D(gl.TEXTURE_2D, 1, fmt, w, h);
  return t;
}
function setupFBOs(w,h){
  if (accumFBO && w===fbw && h===fbh) return;
  fbw=w; fbh=h;
  for (const t of [accumTex, subTex]) if (t) gl.deleteTexture(t);
  for (const f of [accumFBO, subFBO]) if (f) gl.deleteFramebuffer(f);
  if (subDepth) gl.deleteRenderbuffer(subDepth);
  // accumulation buffer (createFramebuffers: RGBA32F additive target)
  accumTex = makeTex(w, h, floatOK ? gl.RGBA32F : gl.RGBA8);
  accumFBO = gl.createFramebuffer();
  gl.bindFramebuffer(gl.FRAMEBUFFER, accumFBO);
  gl.framebufferTexture2D(gl.FRAMEBUFFER, gl.COLOR_ATTACHMENT0, gl.TEXTURE_2D, accumTex, 0);
  // per-camera subframe buffer with DEPTH (cameraFBO: fg/bg depth-tested)
  subTex = makeTex(w, h, gl.RGBA8);
  subDepth = gl.createRenderbuffer();
  gl.bindRenderbuffer(gl.RENDERBUFFER, subDepth);
  gl.renderbufferStorage(gl.RENDERBUFFER, gl.DEPTH_COMPONENT24, w, h);
  subFBO = gl.createFramebuffer();
  gl.bindFramebuffer(gl.FRAMEBUFFER, subFBO);
  gl.framebufferTexture2D(gl.FRAMEBUFFER, gl.COLOR_ATTACHMENT0, gl.TEXTURE_2D, subTex, 0);
  gl.framebufferRenderbuffer(gl.FRAMEBUFFER, gl.DEPTH_ATTACHMENT, gl.RENDERBUFFER, subDepth);
}

// isVisible (RigScene.cpp:1040-1066): a camera is culled when every
// near-infinity probe point lands outside the clip frustum
function cameraVisible(c, vp){
  if (!c.cull_points) return true;
  for (const p of c.cull_points){
    const x = vp[0]*p[0]+vp[4]*p[1]+vp[8]*p[2]+vp[12];
    const y = vp[1]*p[0]+vp[5]*p[1]+vp[9]*p[2]+vp[13];
    const w = vp[3]*p[0]+vp[7]*p[1]+vp[11]*p[2]+vp[15];
    if (w > 0 && -w < x && x < w && -w < y && y < w) return true;
  }
  return false;
}

// displacement fade (render() :1087-1095): 1 inside 0.5 m, 0.05 past 0.75 m
function resolveFade(){
  const d = Math.hypot(eye[0]-rigCenter[0], eye[1]-rigCenter[1], eye[2]-rigCenter[2]);
  const f = 0.05 + 0.95 * Math.max(0, Math.min(1, (d - 0.75) / (0.5 - 0.75)));
  return f * f;
}

async function loadMesh(frame, id, bg){
  const key = (bg?"bg:":"")+frame+"/"+id;
  if (meshes[key]) return meshes[key];
  const buf = await (await fetch(`/${bg?"bgmesh":"mesh"}/${frame}/${id}.bin`)).arrayBuffer();
  const [nv, nf] = new Uint32Array(buf, 0, 2);
  const pos = new Float32Array(buf, 8, nv*3);
  const uv  = new Float32Array(buf, 8+nv*12, nv*2);
  const idx = new Uint32Array(buf, 8+nv*20, nf*3);
  const vao = gl.createVertexArray();
  gl.bindVertexArray(vao);
  const pb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,pb);gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
  gl.enableVertexAttribArray(0);gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);
  const ub=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,ub);gl.bufferData(gl.ARRAY_BUFFER,uv,gl.STATIC_DRAW);
  gl.enableVertexAttribArray(1);gl.vertexAttribPointer(1,2,gl.FLOAT,false,0,0);
  const ib=gl.createBuffer();gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ib);gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,idx,gl.STATIC_DRAW);
  gl.bindVertexArray(null);
  return meshes[key] = {vao, count: nf*3};
}
async function loadTexture(frame, id){
  const key = frame+"/"+id;
  if (textures[key]) return textures[key];
  const img = await createImageBitmap(await (await fetch(`/color/${frame}/${id}.png`)).blob());
  const t = gl.createTexture();
  gl.bindTexture(gl.TEXTURE_2D, t);
  gl.texImage2D(gl.TEXTURE_2D, 0, gl.RGBA, gl.RGBA, gl.UNSIGNED_BYTE, img);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MIN_FILTER, gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_MAG_FILTER, gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_S, gl.CLAMP_TO_EDGE);
  gl.texParameteri(gl.TEXTURE_2D, gl.TEXTURE_WRAP_T, gl.CLAMP_TO_EDGE);
  return textures[key] = t;
}

function fullscreenPass(prog, tex){
  gl.useProgram(prog);
  gl.activeTexture(gl.TEXTURE0);
  gl.bindTexture(gl.TEXTURE_2D, tex);
  gl.uniform1i(gl.getUniformLocation(prog,"tex"), 0);
  gl.bindBuffer(gl.ARRAY_BUFFER, quadBuf);
  gl.enableVertexAttribArray(0);
  gl.vertexAttribPointer(0,2,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.TRIANGLE_STRIP, 0, 4);
}

function renderEye(frame, vp, kIPD, vx, vw, vh){
  // clearAccumulation (RigScene.cpp:977-1003)
  gl.bindFramebuffer(gl.FRAMEBUFFER, accumFBO);
  gl.viewport(0,0,fbw,fbh);
  gl.clearColor(0,0,0,0); gl.clear(gl.COLOR_BUFFER_BIT);

  let drawn = 0, culledN = 0;
  for (const c of scene.cameras){
    const mesh = meshes[frame+"/"+c.id], tex = textures[frame+"/"+c.id];
    if (!mesh || !tex) continue;
    if (!cameraVisible(c, vp)){ culledN++; continue; }

    // renderSubframe: depth-tested draw of the camera mesh (+ background
    // layer mesh after it) into the private subframe FBO
    gl.bindFramebuffer(gl.FRAMEBUFFER, subFBO);
    gl.viewport(0,0,fbw,fbh);
    gl.clearColor(0,0,0,0); gl.clearDepth(1.0);
    gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
    gl.enable(gl.DEPTH_TEST);
    gl.disable(gl.BLEND);
    gl.useProgram(progMesh);
    gl.uniformMatrix4fv(gl.getUniformLocation(progMesh,"transform"), false, vp);
    gl.uniform1f(gl.getUniformLocation(progMesh,"kIPD"), kIPD);
    gl.activeTexture(gl.TEXTURE0);
    gl.bindTexture(gl.TEXTURE_2D, tex);
    gl.uniform1i(gl.getUniformLocation(progMesh,"tex"), 0);
    gl.bindVertexArray(mesh.vao);
    gl.drawElements(gl.TRIANGLES, mesh.count, gl.UNSIGNED_INT, 0);
    const bgMesh = meshes["bg:"+frame+"/"+c.id];
    if (bgMesh){
      gl.bindVertexArray(bgMesh.vao);
      gl.drawElements(gl.TRIANGLES, bgMesh.count, gl.UNSIGNED_INT, 0);
    }
    gl.bindVertexArray(null);
    gl.disable(gl.DEPTH_TEST);

    // updateAccumulation: exponential re-weight + premultiplied add
    gl.bindFramebuffer(gl.FRAMEBUFFER, accumFBO);
    gl.enable(gl.BLEND);
    gl.blendFuncSeparate(gl.SRC_ALPHA, gl.ONE, gl.ONE, gl.ONE);
    fullscreenPass(progUpdate, subTex);
    gl.disable(gl.BLEND);
    drawn++;
  }

  // resolveAccumulation with the displacement fade, into this eye's viewport
  const fade = resolveFade();
  gl.bindFramebuffer(gl.FRAMEBUFFER, null);
  gl.viewport(vx,0,vw,vh);
  gl.useProgram(progQuad);
  gl.uniform1f(gl.getUniformLocation(progQuad,"fade"), fade);
  fullscreenPass(progQuad, accumTex);
  return {drawn, culledN, fade};
}

async function draw(){
  if (!scene) return;
  const frame = frames[frameIdx];
  const w = canvas.clientWidth, h = canvas.clientHeight;
  canvas.width = w; canvas.height = h;
  const wEye = stereo ? (w >> 1) : w;
  setupFBOs(wEye, h);
  const look = lookDir(eye, yaw, pitch);
  const vp = mul(persp(1.2, wEye/h, 0.05, 2000.0), look.m);

  let stats;
  if (stereo){
    // side-by-side ODS: left eye kIPD > 0, right eye negated
    // (RigScene.cpp cameraVS kIPD comment; SimpleMeshRenderer.cpp:409-414)
    stats = renderEye(frame, vp, +halfIpdM, 0, wEye, h);
    renderEye(frame, vp, -halfIpdM, wEye, w - wEye, h);
  } else {
    stats = renderEye(frame, vp, 0.0, 0, w, h);
  }

  window.viewerState.drawn = stats.drawn;
  window.viewerState.culled = stats.culledN;
  window.viewerState.fade = stats.fade;
  window.viewerState.stereo = stereo;
  hud.textContent = `frame ${frame}  (${frameIdx+1}/${frames.length})  cameras ${stats.drawn}/${scene.cameras.length} (culled ${stats.culledN})  fade ${stats.fade.toFixed(2)}${stereo?"  [stereo]":""}`
    + `\neye ${eye.map(v=>v.toFixed(2))}  yaw ${yaw.toFixed(2)} pitch ${pitch.toFixed(2)}`
    + `\n[drag] look  [WASD/QE] move  [wheel] dolly  [[/]] frame  [space] play  [3] stereo`;
}

async function ensureFrame(i){
  const frame = frames[i];
  const loads = scene.cameras.flatMap(c => [loadMesh(frame,c.id), loadTexture(frame,c.id)]);
  if (scene.background)
    loads.push(...scene.cameras.map(c => loadMesh(frame,c.id,true)));
  await Promise.all(loads);
}

async function main(){
  scene = await (await fetch("/scene.json")).json();
  frames = scene.frames;
  window.viewerState.frames = frames.length;
  // start at the rig centroid looking along the mean camera forward
  const n = scene.cameras.length;
  eye = [0,1,2].map(k => scene.cameras.reduce((s,c)=>s+c.position[k],0)/n);
  rigCenter = eye.slice();
  const fwd = [0,1,2].map(k => scene.cameras.reduce((s,c)=>s+c.forward[k],0)/n);
  yaw = Math.atan2(fwd[2], fwd[0]); pitch = Math.asin(Math.max(-1,Math.min(1,fwd[1])));
  await ensureFrame(0);
  // readahead (GlViewer.cpp:74)
  for (let i=1; i<Math.min(scene.readahead, frames.length); i++) ensureFrame(i);
  window.viewerState.ready = true;
  const loop = async () => {
    if (playing && frames.length > 1){
      frameIdx = (frameIdx+1) % frames.length;
      await ensureFrame(frameIdx);
      ensureFrame((frameIdx+1) % frames.length);
    }
    await draw();
    requestAnimationFrame(loop);
  };
  loop();
}

// --- input -----------------------------------------------------------------
let dragging=false, lx=0, ly=0;
canvas.addEventListener("mousedown", e=>{dragging=true;lx=e.clientX;ly=e.clientY});
window.addEventListener("mouseup", ()=>dragging=false);
window.addEventListener("mousemove", e=>{
  if(!dragging)return;
  yaw += (e.clientX-lx)*0.004; pitch -= (e.clientY-ly)*0.004;
  pitch = Math.max(-1.5, Math.min(1.5, pitch));
  lx=e.clientX; ly=e.clientY;
});
canvas.addEventListener("wheel", e=>{
  const look=lookDir(eye,yaw,pitch);
  const s = e.deltaY>0?-0.1:0.1;
  eye = eye.map((v,k)=>v+look.f[k]*s);
  e.preventDefault();
});
window.addEventListener("keydown", async e=>{
  const look=lookDir(eye,yaw,pitch); const s=0.08;
  if(e.key==="w")eye=eye.map((v,k)=>v+look.f[k]*s);
  if(e.key==="s")eye=eye.map((v,k)=>v-look.f[k]*s);
  if(e.key==="a")eye=eye.map((v,k)=>v-look.r[k]*s);
  if(e.key==="d")eye=eye.map((v,k)=>v+look.r[k]*s);
  if(e.key==="q")eye[1]-=s;
  if(e.key==="e")eye[1]+=s;
  if(e.key===" "){playing=!playing; e.preventDefault();}
  if(e.key==="3"){stereo=!stereo;}
  if(e.key==="]"){frameIdx=(frameIdx+1)%frames.length; await ensureFrame(frameIdx);}
  if(e.key==="["){frameIdx=(frameIdx-1+frames.length)%frames.length; await ensureFrame(frameIdx);}
});
if (gl) main().catch(e => hud.textContent = "error: " + e);
</script></body></html>
"""
